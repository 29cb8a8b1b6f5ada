"""The paper's protocol: local SVMs, selection, ensembles, the round."""
