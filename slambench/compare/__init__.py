"""The comparisons that decide `correct`: one file a kind,
``compare/<kind>.py``, run for each kind of the driver's ``compared``
(slambench/harness/check.py). A comparison file provides:

- ``CAPTURES`` (optional; default ``(kind,)``): the capture kinds whose
  sampled items it compares, each taking every kind it prefixes (``"k2proj"``
  takes ``"k2proj.tracking"``), in this order;
- ``check(items, cfg, device, tally)``: works each item out again with the
  plain reference (slambench/reference) from the inputs and the port's
  state it holds, and files every compared number in the ``Tally``
  (``tally.frac(name, bad, total)``: a share summed over items;
  ``tally.worst(name, value)``: the largest reading). It runs under
  ``torch.no_grad()`` with TF32 off;
- ``control(items, cfg, device)``: the same items with the port's outputs
  replaced by the control's (the reference computed in the precision below
  the configuration's, put in the port's place), shaped as the port's, so
  that ``check`` then runs on them as on a run. It runs under
  ``torch.no_grad()`` with TF32 on. A kind without a lower precision
  returns its items unchanged.

Each number's limit is in the cell's check file, ``checks/<cell>.json``.
"""
