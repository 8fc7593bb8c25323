"""reftr_torch.cli (port of reftr_tpu.cli)."""
