"""reftr_torch.data (port of reftr_tpu.data): the native tokenizers and
image ops, transforms, samplers, the loader and the REC datasets."""
