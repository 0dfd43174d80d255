"""Launchers, counterpart of ``repro/launch/``: ``serve`` (the LM
serving launcher), ``train`` (the training launcher) and ``steps`` (the
step functions).  The rest of ``launch/`` is not ported yet (ROADMAP
A8h)."""
