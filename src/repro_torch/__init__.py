"""PyTorch / CUDA port of the 1-bit Adam system, for one NVIDIA H100
(Hopper, sm_90a) per process.

The module layout mirrors the JAX package ``repro`` (the reference), so
``repro_torch/core/compression.py`` is the counterpart of
``repro/core/compression.py`` and so on.  The port imports ``torch`` and
numpy only — never JAX, and nothing of ``repro``.

Slice 1: data-parallel 1-bit Adam training of the BERT encoder — the
``onebit_adam`` recipe, the flat Fig. 3 exchange, the replicated state
layout and the manual T_w switch — with hand-written Hopper kernels for
EF 1-bit compress, decompress and the fused Adam update (``kernels/``,
``csrc/``).  Entry point: ``repro_torch.launch.train.run`` /
``python -m repro_torch.launch.train``.

Slice 2: serving the dense decoders (``llama3.2-3b``) — prefill and
KV-cached decode, with the prefill's attention in a hand-written Hopper
flash-attention kernel under ``attn_impl="pallas"``.  Entry point:
``repro_torch.serve.ServeEngine``.
"""
