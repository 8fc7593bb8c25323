"""reftr_torch.models (port of reftr_tpu.models)."""
