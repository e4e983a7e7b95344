"""The port's storage (etcd_tpu/storage): the WAL record codec and the WAL,
raft storage (the Storage contract and MemoryStorage), fleet checkpoints,
the bucketed backend file and its schema (each member's durable applied
state), and the streamed member-snapshot transfer."""
