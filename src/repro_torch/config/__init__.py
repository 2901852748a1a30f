"""Configuration dataclasses (see ``config/base.py``)."""
