"""Host-side utilities of the port (univer_ocr_tpu/utils)."""
