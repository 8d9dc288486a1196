"""The kinds of unit a traffic mix can name: ``portbench/kinds/<kind>.py``
for the ``kind`` of ``portbench/traffic/<mix>.json``, found by that name.

A kind's module defines

* ``NUMBERS``: the names of the numbers its check compares (the keys of a
  cell's ``limits/<cell>.json``);
* ``setup(cfg, traffic, twists, device, spans)``: the state of one problem
  a twist, built through the program; ``state["probs"][k]`` holds
  ``"k_int"`` (the basis's integer wave vectors) and ``"no"``;
* ``unit(state, k)``: one unit on problem ``k``, synchronised; returns its
  record: ``"converged"``, whole counts of the work it did (summed over the
  window for the per-layer metrics) and what ``gaps`` reads;
* ``answers(state)``: each problem's last answers, as host tensors;
* ``reference(cfg, traffic, twist, device, dtype)``: the plain reference's
  answers for one twist;
* ``gaps(prog, ref, records)``: the numbers of one twist;
* ``control(cfg, traffic, twist, device)``: the numbers of the control.
"""
