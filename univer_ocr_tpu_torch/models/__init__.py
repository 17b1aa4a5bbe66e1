"""The OCR cascade of the port: masked forwards, buckets, the host-cascade
pipeline and the predict entry point."""
