"""Parallelism on ``torch.distributed`` (counterpart of
``phi_3_vision_mlx_tpu/parallel``): process groups and device meshes
(``mesh``), Megatron-style tensor parallelism (``sharding``, ``tensor``),
ring-attention context parallelism (``ring_attention``) and the multi-rank
dry run (``dryrun``)."""
