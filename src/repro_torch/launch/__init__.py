"""Launchers, counterpart of ``repro/launch/``: ``serve`` (the LM
serving launcher), ``train`` (the training launcher, one device or a
``torchrun`` world), ``steps`` (the step functions, sharded or not),
``mesh`` (the production and host meshes), and the dry-run on the meta
device: ``dryrun`` (every cell), ``cost`` (the counters, for JAX's
``hlo_cost``), ``analysis`` (the H100 roofline), ``profile_cell`` and
``dryrun_pp``."""
