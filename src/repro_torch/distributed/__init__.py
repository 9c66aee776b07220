"""Distributed serving: named mesh axes over a ``torch.distributed`` group
(or every shard in one process), the sequence-parallel decode attention
and the f-axis tensor parallelism of the whole FFN."""
