"""The port's host server layer (etcd_tpu/server): so far the MVCC store
and its watch layer, which the apply plane's host mode and differential
checks replay through."""
