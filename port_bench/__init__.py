"""The benchmark of the PyTorch and CUDA port (``python_ray_tracer_tpu_torch``).

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything that belongs to one configuration, traffic mix, traffic kind, cell
or per-layer metric is a file of its own, found by its name:
``configs/<name>.json``, ``traffic/<name>.json``, ``kinds/<kind>.py`` (the
generator a traffic file names, with the port's entry points it drives),
``cells/<name>.json`` and ``metrics/<name>.py``. The yardstick lives here too:
the plain reference (``reference/``), the frozen copies of the port's work
arithmetic and random stream (``frozen/``), the window's arithmetic (``core``)
and the trace's reduction (``trace``). Only ``system`` and the kinds import the
port; nothing here imports JAX or the JAX package.
"""
