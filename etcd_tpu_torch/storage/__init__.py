"""The port's storage side-channels (etcd_tpu/storage): so far the streamed
member-snapshot transfer; the backend, schema, WAL and raft storage wait
for the storage slice."""
