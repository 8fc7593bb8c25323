"""reftr_torch.core (port of reftr_tpu.core)."""
