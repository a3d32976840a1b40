"""The detection modules' strings (remediation.py); the host detectors
themselves are not ported."""
