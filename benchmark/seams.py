"""What the program's stages took and gave, in the calls the check records.

Beside the text check (check.py), which holds every answer to the
reference's reading of the page, the check follows the program's stages
from their own inputs, at the seams the host cascade passes:

  * `OCRPipeline.ocr_pages(pages)` -> answers: the recorded calls (every
    `every`-th call of the window from an offset drawn from the seed, so
    that they spread over the whole window) are recorded whole;
  * `OCRPipeline.front_resident(batch_u8)` -> (monochrome map, paragraph
    mask): the pages in, the map and the mask out;
  * `fastpath.line_forward_masked(params, x, h_valid, w_valid, prefix)`:
    the Paragraph FCN on the map and the Line FCN on the paragraph crops;
  * `fastpath.char_forward_masked(params, x, w_valid, ...)`: the Char
    forward on the zoomed lines; its argmax ids are what the program
    decodes.

Each wrapper calls the program's function and, while a recorded call
runs, keeps references to its inputs and outputs (the argmax ids as
int16); nothing is copied or synchronised inside the window.  A seam
that no recorded call passed reads as a failed check, not as a pass.
"""

import sys
import threading
from collections import Counter

#: per recorded call, how many launches of each kind keep their full
#: inputs for the reference (ids and masks are kept for every launch)
KEEP = {'front': 2, 'Paragraph': 2, 'Line': 6, 'Char': 6}


class Recorder:
    def __init__(self):
        self.recording = False
        self.lock = threading.Lock()
        self.calls = []        # per recorded call: answers and fronts
        self.fcn = {'Paragraph': [], 'Line': []}   # (x, hv, wv, pred)
        self.chars = []        # (x or None, w_valid, ids int16)
        self.fired = Counter()
        self._kept = Counter()
        self._saved = []
        self._every = None
        self._offset = 0
        self._n = 0

    def arm(self, every, offset):
        """Record calls offset, offset + every, ..., counted from now."""
        self._every, self._offset, self._n = every, offset, 0

    def disarm(self):
        self._every = None

    def _take(self):
        """Whether the call starting now is recorded (calls into the
        pipeline are one at a time: a closed loop's one caller)."""
        with self.lock:
            if self._every is None:
                return False
            k, self._n = self._n, self._n + 1
            return k % self._every == self._offset

    def start_call(self):
        self._kept.clear()
        self.calls.append({'answers': None, 'fronts': []})
        self.recording = True

    def stop_call(self, answers):
        self.recording = False
        self.calls[-1]['answers'] = answers

    def _keep(self, kind):
        """Count a launch of `kind`; True while the call may keep its full
        inputs."""
        self.fired[kind] += 1
        self._kept[kind] += 1
        return self._kept[kind] <= KEEP[kind]

    # -- the wrappers ----------------------------------------------------
    def install(self):
        import torch
        from univer_ocr_tpu_torch.models import fastpath, pipeline

        orig_ocr = pipeline.OCRPipeline.ocr_pages
        orig_front = pipeline.OCRPipeline.front_resident
        orig_fcn = fastpath.line_forward_masked
        orig_char = fastpath.char_forward_masked
        rec = self

        def ocr_pages(self, pages):
            if not rec._take():
                return orig_ocr(self, pages)
            rec.start_call()
            answers = None
            try:
                answers = orig_ocr(self, pages)
            finally:
                rec.stop_call(answers)
            return answers

        def front_resident(self, batch_u8):
            out = orig_front(self, batch_u8)
            if rec.recording:
                with rec.lock:
                    keep = rec._keep('front')
                    rec.calls[-1]['fronts'].append(
                        (batch_u8, out[0] if keep else None, out[1]))
            return out

        def line_forward_masked(params, x, h_valid, w_valid,
                                prefix='Line', precision=None):
            out = orig_fcn(params, x, h_valid, w_valid, prefix=prefix,
                           precision=precision)
            if rec.recording:
                with rec.lock:
                    if rec._keep(prefix):
                        rec.fcn[prefix].append((x, h_valid, w_valid, out))
            return out

        def char_forward_masked(params, x, w_valid, *args, **kwargs):
            out = orig_char(params, x, w_valid, *args, **kwargs)
            if rec.recording:
                ids = out.argmax(dim=-1).to(torch.int16)
                wv = torch.as_tensor(w_valid, device=x.device).reshape(-1)
                with rec.lock:
                    keep = rec._keep('Char')
                    rec.chars.append((x if keep else None, wv, ids))
            return out

        for attr, orig, new in (('ocr_pages', orig_ocr, ocr_pages),
                                ('front_resident', orig_front,
                                 front_resident)):
            self._saved.append((pipeline.OCRPipeline, attr, orig))
            setattr(pipeline.OCRPipeline, attr, new)
        for orig, new in ((orig_fcn, line_forward_masked),
                          (orig_char, char_forward_masked)):
            for name, mod in list(sys.modules.items()):
                if name.split('.')[0] != 'univer_ocr_tpu_torch' or mod is None:
                    continue
                for attr, val in list(vars(mod).items()):
                    if val is orig:
                        self._saved.append((mod, attr, orig))
                        setattr(mod, attr, new)
        return self

    def uninstall(self):
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)
