"""Parameter-efficient adapters (see ``peft/api.py``)."""
