"""PyTorch/CUDA port of the Octopus reproduction (``repro``).

The streaming pipeline's main path — segmented tracker, MLP engine, CNN or
payload-transformer flow engine, decisions — runs on one NVIDIA H100, in f32
or on the int8 engine datapath, with the paper's collaborative layer and its
unfused ablation, through hand-written CUDA kernels (``kernels/``:
``flow_update``, ``vpe_mm``, ``mm_fused``, ``vpe_mm_q``, ``mm_fused_q``,
``mm_unfused_partials``), each with a plain PyTorch twin that runs on CPU
tensors.  Importing the package builds nothing; the kernels compile at their
first launch.
"""
