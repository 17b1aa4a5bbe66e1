"""System `pipeline`: `OCRPipeline` in the harness's process, built on the
cell's card from the configuration's `page_shape`, `weights`, `precision`
and `pipeline` arguments."""


class PipelineSystem:
    def __init__(self, pipeline, devices):
        self.pipeline = pipeline
        self.devices = devices

    def ocr(self, pages):
        return self.pipeline.ocr_pages(pages)

    def pipelines(self):
        return [self.pipeline]

    def close(self):
        self.pipeline.close()


def build(config, devices, root):
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.weights import load_checkpoint
    weights = load_checkpoint(root / config['weights'], device=devices[0])
    pipeline = OCRPipeline(tuple(config['page_shape']), weights,
                           device=devices[0], precision=config['precision'],
                           **config['pipeline'])
    return PipelineSystem(pipeline, devices)
