"""EVM contract model: an address with associated bytecode.

The port's copy of the JAX package's ethereum/evmcontract.py (reference:
mythril/ethereum/evmcontract.py:14-122): the runtime and creation code,
the runtime and creation `Disassembly` (built lazily: a corpus pass that
only reads the runtime hex never disassembles), their easm views (what
`disassemble` prints) and the bytecode hashes the report's source list
reads. The `code#…#`/`func#…#` search DSL of `leveldb-search` is not
ported (it needs leveldb), and selectors are never looked up online: a
contract asked for `enable_online_lookup` raises.
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

    def __init__(
        self, code="", creation_code="", name="Unknown", enable_online_lookup=False
    ):
        if enable_online_lookup:
            raise NotImplementedError(
                "the online signature lookup (www.4byte.directory) is not "
                "ported: selectors are named from the local signature table"
            )
        self.code = _LINK_PLACEHOLDER.sub("aa" * 20, code or "")
        self.creation_code = _LINK_PLACEHOLDER.sub("aa" * 20, creation_code or "")
        self.name = name
        self._runtime_disassembly = None
        self._creation_disassembly = None

    @property
    def disassembly(self) -> Disassembly:
        if self._runtime_disassembly is None:
            self._runtime_disassembly = Disassembly(self.code)
        return self._runtime_disassembly

    @property
    def creation_disassembly(self) -> Disassembly:
        if self._creation_disassembly is None:
            self._creation_disassembly = Disassembly(self.creation_code)
        return self._creation_disassembly

    def get_easm(self) -> str:
        return self.disassembly.get_easm()

    def get_creation_easm(self) -> str:
        return self.creation_disassembly.get_easm()

    @property
    def bytecode_hash(self):
        return get_code_hash(self.code)

    @property
    def creation_bytecode_hash(self):
        return get_code_hash(self.creation_code)
