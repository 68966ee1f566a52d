"""Device-mesh execution of the counting kernels (counterpart of
kmerdb_tpu/parallel): ``mesh`` builds the mesh, ``runtime`` holds the CLI's
``-mesh`` request, ``sharded`` the kernels' sharded forms.  One process
drives every device; nothing here uses torch.distributed.
"""
