"""PyTorch port of the packed BN-LSTM/GRU serving path, with hand-written
CUDA kernels for Hopper (sm_90a) in place of the JAX package's Pallas
kernels.

Module names mirror `src/repro/` (`repro_torch.core.quantize` is the port of
`repro.core.quantize`, and so on), so each function has an obvious
counterpart.  The port imports neither JAX nor the JAX package; the tests
feed both the same numpy inputs and compare.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
