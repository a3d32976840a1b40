"""Summary-backup plugin namespace (reference keeps this as an empty
stub: mythril/laser/plugin/plugins/summary_backup/__init__.py)."""
