"""The benchmark of ``rqvae_tpu_torch``, the PyTorch and CUDA port, on NVIDIA
H100 cards.

Run one cell of ``BENCHMARK.json`` from the repository root::

    python3 -m portbench.run --workload amazon_train --seed 7 --seconds 40 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``). Everything that belongs
to one configuration, traffic mix or per-layer metric is a file of its own,
found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<mix>.json``: the traffic mix, whose ``kind`` names the loop in
  ``kinds/<kind>.py``;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell.

``reference/`` is the plain PyTorch reference (it imports nothing of the
port), ``judge.py`` the comparisons that decide ``correct``, ``counts.py``
the operation and byte counts and the table of peaks, ``trace.py`` the
reduction of a profiler trace, ``traffic.py`` the generators, ``device.py``
the card, ``readings.py`` the readings the limits were set from. None of
these modules imports JAX or the JAX package.
"""
