"""reftr_torch.tools (port of reftr_tpu.tools): the multi-process
launcher, the HTTP server and the visual dumps."""
