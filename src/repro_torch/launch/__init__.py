"""Launchers, counterpart of ``repro/launch/``: ``serve`` (the LM
serving launcher).  The rest of ``launch/`` is not ported yet (ROADMAP
A8h)."""
