"""The built-in detection modules (reference:
mythril/analysis/module/modules/)."""
