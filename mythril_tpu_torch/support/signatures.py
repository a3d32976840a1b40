"""4-byte function-selector database.

The port's copy of the JAX package's support/signatures.py (reference
parity: mythril/support/signatures.py:79-276): an sqlite table mapping
selectors to text signatures, seeded from `known_signatures.py`. The
table lives in memory, so an analysis reads and writes no file outside
its checkout, and there is no online lookup (4byte.directory) and no
import of Solidity sources.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import List

from mythril_tpu_torch.support.keccak import keccak256
from mythril_tpu_torch.support.known_signatures import KNOWN_SIGNATURES
from mythril_tpu_torch.support.support_utils import Singleton


class SignatureDB(object, metaclass=Singleton):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(":memory:", check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE signatures"
            "(byte_sig VARCHAR(10), text_sig VARCHAR(255),"
            "PRIMARY KEY (byte_sig, text_sig))"
        )
        self._conn.executemany(
            "INSERT OR IGNORE INTO signatures (byte_sig, text_sig) VALUES (?,?)",
            [("0x" + keccak256(sig.encode())[:4].hex(), sig) for sig in KNOWN_SIGNATURES],
        )
        self._conn.commit()

    @staticmethod
    def _normalize_byte_sig(byte_sig: str) -> str:
        if not byte_sig.startswith("0x"):
            byte_sig = "0x" + byte_sig
        if not len(byte_sig) == 10:
            raise ValueError(
                "Invalid byte signature %s, must have 10 characters" % byte_sig
            )
        return byte_sig

    def get(self, byte_sig: str) -> List[str]:
        """The text signatures of a selector."""
        byte_sig = self._normalize_byte_sig(byte_sig)
        with self._lock:
            rows = self._conn.execute(
                "SELECT text_sig FROM signatures WHERE byte_sig=?", (byte_sig,)
            ).fetchall()
        return [r[0] for r in rows]
