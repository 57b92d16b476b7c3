"""Integrations of the PyTorch/CUDA port.

Counterpart of corrosion_tpu/integrations/__init__.py.
"""
