"""Multi-GPU execution of the swarm cycle on torch.distributed
(``shard``), the ranks' launcher (``launch``) and the ranks' entry
functions (``ranks``)."""
