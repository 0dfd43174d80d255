"""Training data, counterpart of ``repro/data/``: the synthetic Markov
LM dataset, keyed by step."""
