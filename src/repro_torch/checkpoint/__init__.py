from repro_torch.checkpoint.manager import CheckpointManager, load_pytree, save_pytree
