"""Data recipes: each module makes a configuration's inputs from a seed
with numpy alone, and is found by the ``recipe`` name in the
configuration's ``data`` block."""
