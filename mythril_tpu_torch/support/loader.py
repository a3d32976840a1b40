"""DynLoader: lazy on-chain data for the symbolic engine.

The port's copy of the JAX package's support/loader.py (reference
equivalent: mythril/support/loader.py): the state layer calls
`read_storage` / `read_balance` when a symbolic account touches a slot it
has no local value for, and `dynld` when a CALL resolves to a foreign
address whose code must be pulled in. All three memoize, and all three
refuse loudly when dynamic loading is off or no RPC client is
configured.

What differs: `deployed_code`, whose only reader in the JAX package is
`myth submit --address` (refused by the port's `submit`: it needs a
chain client), is left out; and the
port has no chain RPC client (the JAX package's
ethereum/interface/rpc is not ported), so the analyzer facade builds
its loader with `eth=None`, and a read that needs a chain raises a
ValueError naming that client, as the JAX loader does when none is
configured.
"""

from __future__ import annotations

import logging
from functools import lru_cache
from typing import Optional

from mythril_tpu_torch.disassembler.disassembly import Disassembly

log = logging.getLogger(__name__)

#: distinct (address, slot) pairs a single analysis plausibly touches
MEMO_SLOTS = 4096

NO_RPC_CLIENT = (
    "Dynamic data loading requires a chain RPC client "
    "(ethereum/interface/rpc), which is not ported"
)


def _canonical_address(address) -> Optional[str]:
    """0x-prefixed, 40-hex-digit, left-zero-padded form of `address`
    (int or hex string); None when it cannot be one."""
    if isinstance(address, int):
        address = f"{address:#042x}"
    elif isinstance(address, str):
        digits = address[2:] if address.startswith("0x") else address
        address = "0x" + digits.rjust(40, "0")
    else:
        return None
    body = address[2:]
    if len(body) != 40:
        return None
    try:
        int(body, 16)
    except ValueError:
        return None
    return address


class DynLoader:
    """On-demand chain reads (storage slots, balances, dependency
    code) through an `EthJsonRpc`-shaped client."""

    def __init__(self, eth, active: bool = True) -> None:
        self.eth = eth
        self.active = active

    def _client(self):
        """The RPC client, or a loud failure when loading is off."""
        if not self.active:
            raise ValueError("Dynamic data loading is disabled")
        if self.eth is None:
            raise ValueError(NO_RPC_CLIENT)
        return self.eth

    @lru_cache(maxsize=MEMO_SLOTS)
    def read_storage(self, contract_address: str, index: int) -> str:
        return self._client().eth_getStorageAt(
            contract_address, position=index, block="latest"
        )

    @lru_cache(maxsize=MEMO_SLOTS)
    def read_balance(self, address: str) -> str:
        return self._client().eth_getBalance(address)

    @lru_cache(maxsize=MEMO_SLOTS)
    def dynld(self, dependency_address) -> Optional[Disassembly]:
        """Code of the contract at `dependency_address`, disassembled;
        None for malformed addresses and codeless accounts."""
        client = self._client()
        address = _canonical_address(dependency_address)
        log.debug("dynld %s -> %s", dependency_address, address)
        if address is None:
            return None
        code = client.eth_getCode(address)
        if not code or code == "0x":
            return None
        return Disassembly(code)
