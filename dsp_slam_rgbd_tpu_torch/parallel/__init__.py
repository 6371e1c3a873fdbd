"""The scale-out tier: an (obj, ray) mesh over `torch.distributed` ranks,
and the reconstruction and bundle adjustment sharded over it."""
