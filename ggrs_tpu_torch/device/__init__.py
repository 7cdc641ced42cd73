"""The device side of the port: the fused SyncTest session, the request
path's rollback backend and ResimCore, the cross-session megabatch core,
the kernels' wrappers with their plain versions, and the plane scaffold."""
