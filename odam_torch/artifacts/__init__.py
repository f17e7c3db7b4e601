"""Tools for the committed trained artifacts: ``validate`` measures the
rehearsal weights on a held-out stream, ``retrain.sh`` recreates them."""
