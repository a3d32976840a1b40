"""The detection modules' issue strings that device issue synthesis reads.

The port's copy of the remediation and description strings of the JAX
package's detection modules (analysis/module/modules/*.py), letter for
letter, so that an issue the port synthesizes from device evidence
(analysis/prepass.py, analysis/evidence.py) reads exactly as the JAX
package's. The modules themselves (the host detectors) are not ported;
each constant here names the module it comes from.
"""

# analysis/module/modules/exceptions.py REMEDIATION
EXCEPTIONS_REMEDIATION = (
    "It is possible to trigger an assertion violation. Note that Solidity assert() statements should "
    "only be used to check invariants. Review the transaction trace generated for this issue and "
    "either make sure your program logic is correct, or use require() instead of assert() if your goal "
    "is to constrain user inputs or enforce preconditions. Remember to validate inputs from both callers "
    "(for instance, via passed arguments) and callees (for instance, via return values)."
)

# analysis/module/modules/integer.py REMEDIATION
INTEGER_REMEDIATION = (
    "It is possible to cause an integer overflow or underflow in the"
    " arithmetic operation. Prevent this by constraining inputs using"
    " the require() statement or use the OpenZeppelin SafeMath"
    " library for integer arithmetic operations. Refer to the"
    " transaction trace generated for this issue to reproduce the"
    " issue."
)

# analysis/module/modules/delegatecall.py REMEDIATION
DELEGATECALL_REMEDIATION = (
    "The smart contract delegates execution to a user-supplied address."
    "This could allow an attacker to execute arbitrary code in the context of this contract "
    "account and manipulate the state of the contract account or execute actions on its behalf."
)

# analysis/module/modules/dependence_on_origin.py REMEDIATION
ORIGIN_REMEDIATION = (
    "The tx.origin environment variable has been found to influence a control flow decision. "
    "Note that using tx.origin as a security control might cause a situation where a user "
    "inadvertently authorizes a smart contract to perform an action on their behalf. It is "
    "recommended to use msg.sender instead."
)

# analysis/module/modules/dependence_on_predictable_vars.py REMEDIATION
PREDICTABLE_VARS_REMEDIATION = (
    "Note that the values of variables like coinbase, gaslimit, block number and timestamp "
    "are predictable and can be manipulated by a malicious miner. Also keep in mind that "
    "attackers know hashes of earlier blocks. Don't use any of those environment variables "
    "as sources of randomness and be aware that use of these variables introduces "
    "a certain level of trust into miners."
)

# analysis/module/modules/unchecked_retval.py REMEDIATION
UNCHECKED_RETVAL_REMEDIATION = (
    "External calls return a boolean value. If the callee halts with an exception, 'false' is "
    "returned and execution continues in the caller. "
    "The caller should check whether an exception happened and react accordingly to avoid unexpected "
    "behavior. For example it is often desirable to wrap external calls in require() so the "
    "transaction is reverted if the call fails."
)

# analysis/module/modules/external_calls.py REMEDIATION
EXTERNAL_CALLS_REMEDIATION = (
    "An external message call to an address specified by the caller is executed. Note that "
    "the callee account might contain arbitrary code and could re-enter any function "
    "within this contract. Reentering the contract in an intermediate state may lead to "
    "unexpected behaviour. Make sure that no state modifications "
    "are executed after this call and/or reentrancy guards are in place."
)

# analysis/module/modules/ether_thief.py REMEDIATION
ETHER_THIEF_REMEDIATION = (
    "Arbitrary senders other than the contract creator can profitably extract Ether "
    "from the contract account. Verify the business logic carefully and make sure that appropriate "
    "security controls are in place to prevent unexpected loss of funds."
)

# analysis/module/modules/state_change_external_calls.py DESCRIPTION_TAIL_TEMPLATE
STATE_CHANGE_DESCRIPTION_TAIL_TEMPLATE = (
    "The contract account state is accessed after an external call to a {} address. "
    "To prevent reentrancy issues, consider accessing the state only before the call, especially if the "
    "callee is untrusted. Alternatively, a reentrancy lock can be used to prevent "
    "untrusted callees from re-entering the contract in an intermediate state."
)
