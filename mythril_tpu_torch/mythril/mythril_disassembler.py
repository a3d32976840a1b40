"""Facade: contract loading and disassembly.

The port's copy of the JAX package's mythril/mythril_disassembler.py
(reference: mythril/mythril/mythril_disassembler.py): loading contracts
from raw bytecode and function-signature hashing.

What the port cannot load is refused, with what it would need named:
`load_from_address` and `get_state_variable_from_storage` need the
chain RPC client (ethereum/interface/rpc), `load_from_solidity` needs a
`solc` binary and the Solidity front end (solidity/), and neither is
ported; `mythril_config.py` and `mythril_leveldb.py` are not ported
either (they configure and search a chain). Selectors are never looked
up online (`enable_online_lookup` raises).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.support.keccak import keccak256

log = logging.getLogger(__name__)

NO_RPC = "the chain RPC client (ethereum/interface/rpc), which is not ported"
NO_SOLC = (
    "a solc binary and the Solidity front end (solidity/), which are not "
    "ported"
)


def get_indexed_address(index: int) -> str:
    """The JAX package's ethereum/util.py:get_indexed_address."""
    return "0x" + (hex(index)[2:] * 40)


class MythrilDisassembler:
    """Loads and disassembles contracts from raw bytecode."""

    def __init__(
        self,
        eth=None,
        solc_version: str = None,
        solc_settings_json: str = None,
        enable_online_lookup: bool = False,
    ) -> None:
        if eth is not None:
            raise NotImplementedError(f"an RPC connection needs {NO_RPC}")
        if solc_version or solc_settings_json:
            raise NotImplementedError(f"solc settings need {NO_SOLC}")
        if enable_online_lookup:
            raise NotImplementedError(
                "the online signature lookup (www.4byte.directory) is not "
                "ported: it needs the network"
            )
        self.eth = None
        self.enable_online_lookup = False
        self.contracts: List[EVMContract] = []

    # -- loading -------------------------------------------------------
    def _adopt(self, contract: EVMContract) -> EVMContract:
        self.contracts.append(contract)
        return contract

    def load_from_bytecode(
        self, code: str, bin_runtime: bool = False, address: Optional[str] = None
    ) -> Tuple[str, EVMContract]:
        """Register a contract from raw hex bytecode."""
        kind = {"code": code} if bin_runtime else {"creation_code": code}
        contract = self._adopt(EVMContract(name="MAIN", **kind))
        return address or get_indexed_address(0), contract

    def load_from_address(self, address: str):
        """Fetch a deployed contract's code over RPC: refused."""
        raise NotImplementedError(f"loading {address} from a chain needs {NO_RPC}")

    def load_from_solidity(self, solidity_files: List[str]):
        """Compile Solidity sources: refused."""
        raise NotImplementedError(
            f"compiling {', '.join(solidity_files)} needs {NO_SOLC}"
        )

    # -- helpers -------------------------------------------------------
    @staticmethod
    def hash_for_function_signature(func: str) -> str:
        """4-byte selector of a function signature."""
        return "0x%s" % keccak256(func.encode())[:4].hex()

    def get_state_variable_from_storage(
        self, address: str, params: Optional[List[str]] = None
    ) -> str:
        """Read storage slots over RPC: refused."""
        raise NotImplementedError(f"reading the storage of {address} needs {NO_RPC}")
