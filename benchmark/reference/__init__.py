"""The benchmark's plain reference: ∇-FOL forward, loss and optimizer step.

Frozen copies of the PyTorch port's plain path (``logic``, ``nn``, ``types``,
``config``, ``ontology`` with its metadata asset, ``program_compiler``,
``featurizer``, ``oracle``, ``cells``, ``calibrator``, ``interpreter``,
``optim`` and ``features``), with every CUDA kernel route left out: the
relation caches come from the plain ``oracle.rel_cache`` and
``oracle.rel_cache_shared``. Nothing here imports the port or the JAX
package (``benchmark/tests/test_bench_imports.py``). The copies are the
yardstick that decides ``correct``, so a change to the program does not
change them; ``benchmark/tests/test_bench_reference.py`` holds them to the
port on the CPU at tiny widths.

``check.py`` judges a run against these modules.
"""
