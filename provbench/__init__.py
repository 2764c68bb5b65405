"""provbench: the benchmark of the provenance index's PyTorch/CUDA port.

One run drives one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) once: ``python3 provbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

Everything is found by name, so that a configuration, a traffic mix, a
metric or a cell is added as new files and entries:

* ``configs/<config>.json``: the source tables' generators, the pipeline as
  an op list, the datasets queries address, and ``source``/``assumed``/
  ``reduced``;
* ``traffic/<mix>.json``: the parameters of a mix, and the loop that
  reads them (``loops/<loop>.py``);
* ``tables/<generator>.py``: a table generator (numpy, from the seed);
* ``steps/<op>.py``: how a pipeline op is applied through the port's
  tracked tables (ops without a file call the tracked method of their name);
* ``reference/ops/<op>.py``: the plain numpy semantics of a pipeline op;
* ``metrics/<metric>.py``: the reader of one metric.

The harness imports the port (``repro_torch``) and its own files only;
``reference/`` imports neither.
"""
