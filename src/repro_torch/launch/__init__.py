"""Launchers, counterpart of ``repro/launch/``: ``serve`` (the LM
serving launcher), ``train`` (the training launcher, one device or a
``torchrun`` world), ``steps`` (the step functions) and ``mesh`` (the
production and host meshes).  The rest of ``launch/`` is not ported yet
(ROADMAP A8h)."""
