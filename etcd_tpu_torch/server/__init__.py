"""The port's host server layer (etcd_tpu/server): the MVCC store and its
watch layer, the lessor, the auth store, the v2 store, version negotiation,
the compactor and ``kvserver.EtcdCluster`` on the torch ``Cluster``."""
