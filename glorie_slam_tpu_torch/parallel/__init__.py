"""Edge sharding of the tracker over ranks (``torch.distributed``, one
process per rank): ``mesh`` holds the group and its collectives,
``launch`` starts the ranks, ``step`` is the sharded tracking step."""
