"""Distribution planning across hosts (``parallel/plan.py``)."""
