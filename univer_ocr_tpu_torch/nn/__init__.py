"""The NN core of the port (univer_ocr_tpu/nn): layer objects over the
port's ops, the DAG Model whose leaf names are the checkpoint's
namespace, the model system, losses, optimizers, the progress tracker
and the checkpoint's save and load.  Steps are eager PyTorch with
autograd on an explicit device."""
