"""Analysis: the corpus prepass and the ownership gate (corpus.py),
device evidence into issues (prepass.py, evidence.py) and the report
(report.py, with its templates)."""
