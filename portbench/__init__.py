"""The benchmark of ``whvi_tpu_torch`` on NVIDIA H100s.

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (:mod:`.run`).
The yardstick lives here: the general loops (:mod:`.loops`) and the
reduction of traces (:mod:`.harness`, :mod:`.trace`), the counts and peaks
(:mod:`.counts`), the inputs (:mod:`.data`), the plain reference
(:mod:`.reference`), and, one file each, the configurations, traffic
mixes, kinds of loop, likelihoods, per-layer readers and limits. From the
program it takes the system under test (:mod:`.program`, and the net
classes that :mod:`.likelihoods` name).
"""
