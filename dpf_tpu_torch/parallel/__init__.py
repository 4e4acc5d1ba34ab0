"""Multi-GPU and the cluster tier (port of ``dpf_tpu/parallel``).

``sharded``: the table row-sharded over a mesh of devices, keys over its
batch axis, entry columns over its byte axis; ``multihost``: processes
joined into one mesh with ``torch.distributed``; ``cluster``: a serving
cluster of granule hosts behind a router that answers a host's loss;
``cluster_net`` / ``cluster_worker``: those hosts in other processes,
over localhost sockets.
"""
