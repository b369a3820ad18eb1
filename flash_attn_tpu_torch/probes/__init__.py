"""Probes of the H100, the counterparts of the TPU probes of benchmarks/
(B13): ``smem_probe`` (benchmarks/vmem_probe.py) and
``mma_exp2_overlap_probe`` (benchmarks/mxu_vpu_overlap_probe.py). Each runs
on the card as ``python -m flash_attn_tpu_torch.probes.<name>``; their
kernels are in csrc/probes.cu."""
