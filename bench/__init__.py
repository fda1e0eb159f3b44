"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix
or per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``; a traffic file's ``kind`` names the runner in
``cells/<kind>.py``.  The yardstick (the frozen generator in ``gen/``,
the closed-form counts in ``counts/``, the peaks, the plain reference in
``reference/`` and the comparison that decides ``correct``) lives here,
apart from the program.
"""
