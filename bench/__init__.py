"""The benchmark of the monitor service on the card (see ``run.py``)."""
