"""PyTorch/CUDA port of the Octopus reproduction (``repro``).

The streaming pipeline's main path — segmented tracker, MLP/CNN engines,
decisions — runs on one NVIDIA H100, in f32 or on the int8 engine datapath,
through hand-written CUDA kernels (``kernels/``: ``flow_update``,
``vpe_mm``, ``mm_fused``, ``vpe_mm_q``, ``mm_fused_q``), each with a plain
PyTorch twin that runs on CPU tensors.  Importing the package builds nothing;
the kernels compile at their first launch.
"""
