"""reftr_torch.train (port of reftr_tpu.train): optimizer groups, LR
schedules, train state, the train and eval steps and the epoch loop."""
