"""reftr_torch.parallel (port of reftr_tpu.parallel): the (data, model)
mesh of ranks (``context``, ``sharding``) and tensor parallelism over its
model axis (``tensor_parallel``)."""
