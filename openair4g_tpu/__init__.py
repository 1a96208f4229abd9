"""openair4g_tpu — an LTE PHY baseband framework in JAX.

A from-scratch reimplementation of the capabilities of OpenAirInterface 4G's
PHY layer (reference: erlgo/openair4G, openair1/PHY + openair1/SIMULATION) as
batched JAX/XLA/Pallas tensor programs:

- 36.212 channel coding: CRC, segmentation, turbo codec, rate matching, HARQ
- 36.211 modulation: scrambling, QAM mapping, OFDM / SC-FDMA, reference signals
- inner receiver: channel estimation, MMSE equalization, max-log LLR demapping
- link-level Monte-Carlo simulators (dlsim/ulsim equivalents) with BLER sweeps
  batched over trials/UE channels and sharded over a device mesh.
"""

__version__ = "0.1.0"
