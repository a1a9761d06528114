"""Plain references of the priced functions, in plain torch at float64:
no kernel, no import of the program. Each module ``<entry>.py`` has

* ``judge(config, traffic, samples, *, device, seed, **cell)``: the
  numbers that decide ``correct`` for ``samples``, a list of (request,
  result) pairs the timed path produced;
* ``control(config, traffic, requests, *, device, seed, dtype)``: the
  reference itself in ``dtype``, put in the program's place, giving
  results of the program's form.
"""
