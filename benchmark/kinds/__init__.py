"""Traffic kinds, one module each, found by the ``kind`` of a traffic mix
(``traffic/<mix>.json``): ``kinds/<kind>.py``.  A kind module provides

- ``Program(env, traffic, dev)``: the program's timed entry, driven at the
  mix's sizes;
- ``Control(conf, traffic, dev, dtype)``: the plain reference in ``dtype``
  in the program's place (the control of the check);
- ``Loop(conf, traffic, seed, dev, solver)``: set-up (``setup()``), the
  measured window (``window(seconds)`` returns the run's record, whose
  ``kind`` the metric readers look at), the traced iteration's phases
  (``phases()``), ``release()``, and ``compared()``: the groups of answers
  the check compares, each (program rows, the draws they came from);
- ``reference(env, draws, prog, traffic)``: the reference's rows of one
  group, from the same draws;
- ``answers(prog, ref)``: the group's answers, one (program, reference)
  pair each, judged alone;
- ``numbers(prog, ref)``: every number the kind can compare of one answer;
  a cell compares those that its ``checks/<cell>.json`` gives a limit;
- ``attempted(rec)`` and ``describe(rec)``: the answers the window
  attempted, and a line on standard error about the window.
"""
