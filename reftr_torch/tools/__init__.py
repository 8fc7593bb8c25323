"""reftr_torch.tools (port of reftr_tpu.tools): the multi-process
launcher, the HTTP server, the serving export, the profilers, the visual
dumps and the log and annotation converters."""
