"""Transformer building blocks: tensor-parallel layers at world size 1,
`functional`, the enums, and context parallelism (`context_parallel`
over `parallel_state`'s process groups)."""
