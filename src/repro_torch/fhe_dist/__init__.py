"""Distributed FHE over `torch.distributed` (paper §III-C, §IV-A, §IV-F
on a device mesh): the limb-sharded layout (`layout`), the inter-bank
base conversion as mesh collectives (`collective_bconv`) and the
load-save pipeline across ranks (`pipeline_exec`). The mesh itself is
`repro_torch.launch.mesh`."""
