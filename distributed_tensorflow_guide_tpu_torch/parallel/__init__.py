"""Parallel strategies: data parallelism over a mesh axis (with bucketed
gradient all-reduce), FSDP, tensor (with Megatron sequence parallelism),
pipeline and expert parallelism, sequence parallelism, the async-PS
family and its host emulator, gradient accumulation."""
