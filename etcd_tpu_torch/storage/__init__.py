"""The port's storage (etcd_tpu/storage): the WAL record codec, the
bucketed backend file and its schema (each member's durable applied state),
and the streamed member-snapshot transfer; the WAL, raft storage and fleet
checkpoints wait for their slice."""
