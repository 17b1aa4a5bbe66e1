"""What decides `correct`: the program's outputs held to the plain
reference (reference/cascade.py, float32 with TF32 off), after the window.

Two kinds, both in every configuration's `check.kinds` today:

  * `text`: every answer the window served, against the reference's text
    of its pool page, which the reference reads from the page itself with
    its own crops, line plans and zoom.  `cer`: edits over reference
    characters of all those answers (the worst answer's rate goes on an
    earlier line: it swings with the page, and the control's does not
    reach three times it).  A crop, a line plan or a zoom gone wrong, a
    line dropped or a glyph altered moves it.
  * `seams` (seams.py): in the calls the recorder took, spread over the
    window, the reference takes the program's own inputs at each seam
    and the numbers are the widest departures of the program's outputs
    from it: `mono_err`, `paragraph_err`, `line_err` (largest absolute
    difference of the maps over each valid region), `char_gap` (the
    widest gap by which the logit of an id the program served lies below
    the reference's best, over every valid column), and, exactly,
    `paragraphs_off` (answers whose paragraph count is not the count of
    4-connected components of the program's own paragraph mask) and
    `lines_unexplained` (answer lines that are no run-length decode of
    the ids the program's Char stage gave in that call).

The harness adds `missing`: answers that never came or that failed.  The
control (`control=True`) puts the reference, with every operand of its
convolutions and products rounded to float8 (e4m3, one scale per
tensor), in the program's place.
"""

import math
from collections import Counter

import numpy as np
from scipy import ndimage

from . import core


def fp8(t):
    import torch
    scale = t.abs().amax().clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def load_reference(config, device):
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = core.load_module(core.BENCH / 'reference'
                           / f'{config["reference"]}.py', 'bench_reference')
    weights = mod.load_weights(core.ROOT / config['weights'], device)
    return mod, mod.Reference(weights, device), mod.Reference(weights, device,
                                                              quant=fp8)


def levenshtein(a, b):
    """Edit distance (insert, delete, substitute; one each)."""
    if not a or not b:
        return max(len(a), len(b))
    bb = np.frombuffer(b.encode('utf-32-le'), np.uint32)
    j = np.arange(len(bb) + 1)
    prev = j.copy()
    tmp = np.empty_like(prev)
    for i, ch in enumerate(a, 1):
        tmp[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + (bb != ord(ch)), out=tmp[1:])
        prev = np.minimum.accumulate(tmp - j) + j
    return int(prev[-1])


def page_text(answer):
    return '\n\n'.join('\n'.join(lines) for lines in answer)


def text_check(config, answers, pool, device, control=False):
    """answers: [(pool index, [paragraph][line] text or None)]; every
    served answer is compared, each pool page read once by each side."""
    served = sorted({i for i, a in answers if a is not None})
    _, ref, ctl = load_reference(config, device)
    collapse = config['check']['collapse_runs']
    truth = {i: page_text(ref.read_page(pool[i], collapse)[0])
             for i in served}
    fake = ({i: page_text(ctl.read_page(pool[i], collapse)[0])
             for i in served} if control else {})
    dist = {}
    edits = chars = 0
    worst = 0.0
    compared = 0
    for i, answer in answers:
        if answer is None:
            continue
        text = fake[i] if control else page_text(answer)
        if (i, text) not in dist:
            dist[(i, text)] = levenshtein(text, truth[i])
        d, n_ref = dist[(i, text)], max(1, len(truth[i]))
        edits += d
        chars += n_ref
        worst = max(worst, d / n_ref)
        compared += 1
    cer = edits / chars if chars else math.inf
    return {'cer': cer}, {'pages_read': len(served),
                          'answers_compared': compared,
                          'cer_worst_answer': worst}


def seams_check(config, recorder, device, control=False):
    """The seams of the calls `recorder` recorded (seams.py)."""
    import torch
    mod, ref, ctl = load_reference(config, device)
    numbers = {}
    fronts = [f for call in recorder.calls for f in call['fronts']]

    # the front: the map against the reference on the same pages, the
    # Paragraph FCN on the program's map
    err = 0.0
    for pages, m, _ in fronts:
        if m is None:
            continue
        x = pages.to(device).permute(0, 3, 1, 2).float() / 255.0
        want = ref.monochrome(x)
        got = (ctl.monochrome(x) if control
               else m.to(device).permute(0, 3, 1, 2))
        err = max(err, float((got - want).abs().max()))
    numbers['mono_err'] = err if recorder.fired['front'] else math.inf

    for prefix, name in (('Paragraph', 'paragraph_err'), ('Line', 'line_err')):
        err = 0.0
        for x, hv, wv, pred in recorder.fcn[prefix]:
            x = x.to(device)
            pred = pred.to(device)
            hv = torch.as_tensor(hv).reshape(-1).expand(x.shape[0]).tolist()
            wv = torch.as_tensor(wv).reshape(-1).expand(x.shape[0]).tolist()
            for b in range(x.shape[0]):
                h, w = int(hv[b]), int(wv[b])
                if h < 16 or w < 16:
                    continue        # batch filler
                xb = x[b:b + 1, :h, :w].permute(0, 3, 1, 2)
                want = ref.fcn(xb, prefix)
                got = (ctl.fcn(xb, prefix) if control
                       else pred[b:b + 1, :h, :w].permute(0, 3, 1, 2))
                err = max(err, float((got - want).abs().max()))
        numbers[name] = err if recorder.fcn[prefix] else math.inf

    # Char: the reference's logits at the ids the program served
    gap = 0.0
    decoded = Counter()
    collapse = config['check']['collapse_runs']
    for x, wv, ids in recorder.chars:
        wv = wv.cpu().tolist()
        ids_host = ids.cpu().numpy()
        for n, w in enumerate(wv):
            w = int(w)
            decoded[mod.decode(ids_host[n, :max(w, 0)].astype(np.int64),
                               collapse).strip()] += 1
            if x is None or w <= 0:
                continue
            line = x[n, :, :w, 0].to(device).float()
            logits = ref.char_logits(line)
            served = (ctl.char_logits(line).argmax(dim=1) if control
                      else ids[n, :w].to(device).long())
            g = logits.max(dim=1).values - logits.gather(
                1, served[:, None])[:, 0]
            gap = max(gap, float(g.max()))
    numbers['char_gap'] = gap if recorder.fired['Char'] else math.inf

    # exact: each answer's paragraphs are the 4-connected components of
    # the program's own paragraph mask of that page (the call's front
    # rows in order, blank filler rows left out), and every answer line
    # is a run-length decode of ids the program's Char stage gave
    off, lines, answers = 0, Counter(), 0
    for call in recorder.calls:
        got = call['answers']
        rows = [(p, mask) for pages, _, masks in call['fronts']
                for p, mask in zip(pages.cpu().numpy(), masks.cpu().numpy())]
        counts = [ndimage.label(mask[:, :, 0] > 0)[1] for p, mask in rows
                  if p.any()]
        if got is None or len(counts) != len(got):
            off += len(counts) or 1
            continue
        answers += len(got)
        off += sum(c != len(a) for c, a in zip(counts, got))
        lines.update(line for a in got for para in a for line in para)
    numbers['paragraphs_off'] = off if recorder.calls else math.inf
    numbers['lines_unexplained'] = (sum((lines - decoded).values())
                                    if recorder.fired['Char'] else math.inf)
    return numbers, {'recorded_calls': len(recorder.calls),
                     'recorded_answers': answers,
                     'launches': dict(recorder.fired)}


def judge(numbers, limits):
    """-> (correct, [(name, value, limit)]): every number at or under its
    limit."""
    rows = [(name, numbers[name], limits[name]) for name in limits]
    return all(v <= lim for _, v, lim in rows), rows
