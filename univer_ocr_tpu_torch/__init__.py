"""univer_ocr_tpu_torch — the PyTorch/CUDA port of univer_ocr_tpu.

The same OCR cascade (Monochrome -> Paragraph -> paragraph crop/deskew ->
Line -> line crop/zoom -> Char -> text) on an NVIDIA H100.  Module layout
and names follow the JAX package so that each function has an obvious
counterpart; the code inside is plain PyTorch on an explicit device:

  * `ops/`: NHWC convolution, dense, activations, upsampling and the
    precision policy ('highest' | 'bf16');
  * `ops/kernels/`: the two hand-written CUDA kernels that replace the JAX
    package's Pallas kernels (fused Monochrome block, fused Char head),
    built with one `nvcc` call and bound with `ctypes`;
  * `models/`: masked fixed-shape forwards, shape buckets, the host-cascade
    `OCRPipeline` and the `predict` entry point;
  * `parallel/`: the device mesh, driven by one process (sharded
    serving through `OCRPipeline(mesh=...)`, DP and TP training steps);
  * `interpreter`: the host CV between the models (numpy + scipy);
  * `weights`: the `model_weights.json` checkpoint loader.

Entry points run on `cuda` unless the caller passes `device='cpu'`.  The
package imports torch, numpy and scipy, never JAX and nothing of
`univer_ocr_tpu`.
"""

__version__ = "0.1.0"
