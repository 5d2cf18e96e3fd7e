"""The benchmark of the PyTorch and CUDA port (``tacotron2_vae_torch``).

``python3 -B -m portbench.run --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once (``run.py``).  Importing this
package imports nothing.
"""
