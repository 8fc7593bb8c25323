"""reftr_torch.parallel (port of reftr_tpu.parallel): the data-parallel
layout of the input pipeline."""
