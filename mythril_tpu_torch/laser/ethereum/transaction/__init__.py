"""Transaction models + symbolic/concolic setup (reference:
mythril/laser/ethereum/transaction/__init__.py)."""

from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    BaseTransaction,
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
    get_next_transaction_id,
    reset_transaction_ids,
)
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import (
    ACTORS,
    execute_contract_creation,
    execute_message_call,
)
