"""EVM contract model: an address with associated bytecode.

The port's copy of the JAX package's ethereum/evmcontract.py (reference:
mythril/ethereum/evmcontract.py:14-122): the runtime and creation code,
the runtime `Disassembly` (built lazily: a corpus pass that only reads
the runtime hex never disassembles) and the bytecode hashes the report's
source list reads. The `code#…#`/`func#…#` search DSL of `leveldb-search`
and the easm views are not ported: nothing in the port queries them.
"""

from __future__ import annotations

import re

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.support.support_utils import get_code_hash

#: solc emits __[libname]______ placeholders for compile-time linking;
#: they are pinned to a dummy address so the hex decodes
_LINK_PLACEHOLDER = re.compile(r"_{2}.{38}")


class EVMContract:
    """An address with associated code."""

    def __init__(self, code="", creation_code="", name="Unknown"):
        self.code = _LINK_PLACEHOLDER.sub("aa" * 20, code or "")
        self.creation_code = _LINK_PLACEHOLDER.sub("aa" * 20, creation_code or "")
        self.name = name
        self._runtime_disassembly = None

    @property
    def disassembly(self) -> Disassembly:
        if self._runtime_disassembly is None:
            self._runtime_disassembly = Disassembly(self.code)
        return self._runtime_disassembly

    @property
    def bytecode_hash(self):
        return get_code_hash(self.code)

    @property
    def creation_bytecode_hash(self):
        return get_code_hash(self.creation_code)
