"""Per-call execution environment.

Reference parity: mythril/laser/ethereum/state/environment.py:12-79 —
the I_* tuple of the Yellow Paper: active account, sender, calldata,
gas price, call value, origin, code, plus symbolic block context and
the STATICCALL write-protection flag.
"""

from __future__ import annotations

from typing import Optional

from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import BaseCalldata
from mythril_tpu_torch.laser.smt import BitVec, symbol_factory


class Environment:
    """The environment of a global state."""

    def __init__(
        self,
        active_account: Account,
        sender: BitVec,
        calldata: BaseCalldata,
        gasprice: BitVec,
        callvalue: BitVec,
        origin: BitVec,
        code=None,
        basefee: Optional[BitVec] = None,
        static: bool = False,
    ):
        self.active_account = active_account
        self.active_function_name = ""
        self.address = active_account.address
        self.code = active_account.code if code is None else code
        self.sender = sender
        self.calldata = calldata
        self.gasprice = gasprice
        self.origin = origin
        self.callvalue = callvalue
        self.static = static
        self.basefee = basefee if basefee is not None else symbol_factory.BitVecSym(
            "basefee", 256
        )
        # symbolic block context (reference keeps these symbolic so
        # detection modules can reason about miner influence)
        self.block_number = symbol_factory.BitVecSym("block_number", 256)
        self.chainid = symbol_factory.BitVecSym("chain_id", 256)

    def __copy__(self) -> "Environment":
        new = Environment(
            self.active_account,
            self.sender,
            self.calldata,
            self.gasprice,
            self.callvalue,
            self.origin,
            code=self.code,
            basefee=self.basefee,
            static=self.static,
        )
        new.block_number = self.block_number
        new.chainid = self.chainid
        new.active_function_name = self.active_function_name
        return new

    def __str__(self):
        return f"Environment(address={self.address})"
