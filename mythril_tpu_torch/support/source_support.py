"""Maps analyzed bytecode to source identifiers for jsonv2 reports.

The port's copy of the JAX package's support/source_support.py
(reference: mythril/support/source_support.py:5-63): it collects
source names and bytecode hashes from the analyzed contracts so
`Report.as_swc_standard_format` can emit `sourceList` indices.
"""

from __future__ import annotations

from typing import List


class Source:
    def __init__(self, source_type=None, source_format=None, source_list=None):
        self.source_type = source_type
        self.source_format = source_format
        self.source_list: List[str] = source_list or []
        self._source_hash: List[str] = []

    def get_source_from_contracts_list(self, contracts) -> None:
        if contracts is None or len(contracts) == 0:
            return
        first = contracts[0]
        if hasattr(first, "solidity_files"):
            self.source_type = "solidity-file"
            self.source_format = "text"
            for contract in contracts:
                self.source_list.extend(
                    file.filename for file in contract.solidity_files
                )
                self._source_hash.append(contract.bytecode_hash)
                self._source_hash.append(contract.creation_bytecode_hash)
        else:
            self.source_format = "evm-byzantium-bytecode"
            self.source_type = (
                "raw-bytecode"
                if getattr(first, "creation_code", None)
                else "ethereum-address"
            )
            for contract in contracts:
                if getattr(contract, "creation_code", None):
                    self.source_list.append(contract.creation_bytecode_hash)
                    self._source_hash.append(contract.creation_bytecode_hash)
                if getattr(contract, "code", None):
                    self.source_list.append(contract.bytecode_hash)
                    self._source_hash.append(contract.bytecode_hash)

    def get_source_index(self, bytecode_hash: str) -> int:
        if bytecode_hash in self._source_hash:
            return self._source_hash.index(bytecode_hash)
        self._source_hash.append(bytecode_hash)
        return len(self._source_hash) - 1
