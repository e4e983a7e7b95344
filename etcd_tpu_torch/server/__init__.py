"""The port's host server layer (etcd_tpu/server): the MVCC store and its
watch layer, the lessor, the auth store, the v2 store, version negotiation,
the compactor, ``kvserver.EtcdCluster`` on the torch ``Cluster`` and the v3
and v2 JSON/HTTP gateway (``v3rpc``, ``v2http``, ``v2auth``)."""
