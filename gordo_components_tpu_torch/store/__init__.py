"""The port's model store (copy of ``gordo_components_tpu/store/``):
checksummed manifests, atomic commits, generations with rollback, and the
build journal. The on-disk formats are the reference's, so either package
reads, verifies and rolls back a root the other committed."""
