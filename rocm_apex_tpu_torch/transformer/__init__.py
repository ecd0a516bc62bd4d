"""Transformer building blocks: the tensor-parallel layers and mappings,
`functional`, the enums, and context parallelism (`context_parallel`),
over `parallel_state`'s process groups."""
