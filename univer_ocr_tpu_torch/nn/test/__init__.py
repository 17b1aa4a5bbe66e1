"""Script batteries of the NN core (univer_ocr_tpu/nn/test), run through
`python -m univer_ocr_tpu_torch.test_nn {test_gradients|test_identity}
[use_gpu]` or the web app's /test-nn page."""
