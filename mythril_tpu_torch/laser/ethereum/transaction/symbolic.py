"""The named transaction senders (creator, attacker, bystander).

The port's copy of `Actors` and `ACTORS` from the JAX package's
laser/ethereum/transaction/symbolic.py (reference:
mythril/laser/ethereum/transaction/symbolic.py), over the port's own
`symbol_factory`. Issue synthesis phrases a witness's sender as
`ACTORS.attacker` (analysis/prepass.py). The symbolic message call and
contract creation drivers belong to the host engine, which is not
ported.
"""

from __future__ import annotations

from typing import Optional

from mythril_tpu_torch.laser.smt import symbol_factory

_CREATOR_DEFAULT = 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE
_ATTACKER_DEFAULT = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
_BYSTANDER_DEFAULT = 0xAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA


class Actors:
    """Well-known transaction senders; issue reports and detector
    queries are phrased against these addresses."""

    _PROTECTED = ("CREATOR", "ATTACKER")

    def __init__(
        self,
        creator=_CREATOR_DEFAULT,
        attacker=_ATTACKER_DEFAULT,
        someguy=_BYSTANDER_DEFAULT,
    ):
        as_term = lambda v: symbol_factory.BitVecVal(v, 256)  # noqa: E731
        self.addresses = {
            "CREATOR": as_term(creator),
            "ATTACKER": as_term(attacker),
            "SOMEGUY": as_term(someguy),
        }

    def __setitem__(self, actor: str, address: Optional[str]):
        if address is None:
            if actor in self._PROTECTED:
                raise ValueError("Can't delete creator or attacker address")
            del self.addresses[actor]
            return
        if not address.startswith("0x"):
            raise ValueError("Actor address not in valid format")
        self.addresses[actor] = symbol_factory.BitVecVal(
            int(address[2:], 16), 256
        )

    def __getitem__(self, actor: str):
        return self.addresses[actor]

    def __len__(self):
        return len(self.addresses)

    @property
    def creator(self):
        return self.addresses["CREATOR"]

    @property
    def attacker(self):
        return self.addresses["ATTACKER"]


ACTORS = Actors()
