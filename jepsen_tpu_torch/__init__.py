"""jepsen_tpu_torch — the knossos-style linearizability check in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100.

A port of `jepsen_tpu` (JAX on a TPU), which stays in the repository as
the reference. It imports nothing of `jepsen_tpu` and no JAX: the host
modules it needs are its own copies. This slice carries the single-
history check through the bit-packed dense engine:

    checker.linearizable.Linearizable(model).check(test, history)
      -> parallel.engine.analysis      (host: encode, route)
      -> parallel.bitdense             (device: the per-event scan)
      -> parallel.closure_kernels      (kernel K1, kernels/closure.cu)
      -> parallel.engine.extract_final_paths  (host: counterexample)

Entry points run on the card (device=None) and raise without one unless
the caller asks for device="cpu".
"""
