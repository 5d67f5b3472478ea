"""Parallelism on ``torch.distributed``: collectives over mesh axes, the
sharding rules, int8 gradient exchange and the EDT-scheduled pipeline
(the port of the reference package's ``parallel``)."""
