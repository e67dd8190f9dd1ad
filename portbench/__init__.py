"""The benchmark of bqueryd_tpu_torch, the PyTorch/CUDA port, on its served
path: clients of ``bqueryd_tpu_torch.rpc.RPC`` over ZMQ, a controller
process and one calc worker process on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells; each cell's
configuration, traffic mix and per-layer metrics live in files of their
own (``configs/``, ``traffic/``, ``loops/``, ``metrics/``), found by name.
Nothing here imports JAX or the JAX package; ``reference.py`` imports
nothing of the port either.
"""
