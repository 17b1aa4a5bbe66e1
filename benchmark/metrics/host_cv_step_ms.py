"""`host_cv_step_ms.<step>.<suffix>`: milliseconds per page served in the
window of one host CV step of the host cascade, the step's wall seconds
summed over the pool threads that ran it:

  * `para_label`: the page's paragraph-mask CCL;
  * `para_select`: per paragraph, its component mask, bbox and masked
    crop of the monochrome map;
  * `para_deskew`: per paragraph, the deskew angle, both rotations, the
    second bbox and the padding to a multiple of 16;
  * `line_plan`: per paragraph, the line plan from its band masks;
  * `line_extract`: per line, its rotation, zoom and padding."""


def read(name, rec):
    step = name.split('.')[1]
    n = rec['counts']['pages']
    if not n or step not in rec['timers']:
        return None
    return 1e3 * rec['timers'][step]['total_s'] / n
