"""The port's GNNs (the counterpart of ``repro.models.gnn``): MeshGraphNet,
PNA, SchNet and NequIP over padded edge lists, their segment ops and batch
builders (``common``) and the SO(3) tables NequIP couples with (``so3``)."""
