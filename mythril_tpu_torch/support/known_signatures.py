"""Built-in seed of widely-used function signatures.

The port's copy of the JAX package's support/known_signatures.py: the
reference ships a prepopulated ~3MB signatures.db asset
(mythril/support/assets/signatures.db); this compact seed covers the
signatures that dominate real contracts (ERC-20/721/1155, ownable and
pausable admin surfaces, common DeFi entry points) so reports name
functions on a fresh installation, with no online lookup.
"""

KNOWN_SIGNATURES = [
    # ERC-20
    "totalSupply()",
    "balanceOf(address)",
    "transfer(address,uint256)",
    "transferFrom(address,address,uint256)",
    "approve(address,uint256)",
    "allowance(address,address)",
    "name()",
    "symbol()",
    "decimals()",
    "mint(address,uint256)",
    "burn(uint256)",
    "burnFrom(address,uint256)",
    "increaseAllowance(address,uint256)",
    "decreaseAllowance(address,uint256)",
    # ERC-721 / 1155
    "ownerOf(uint256)",
    "safeTransferFrom(address,address,uint256)",
    "safeTransferFrom(address,address,uint256,bytes)",
    "setApprovalForAll(address,bool)",
    "getApproved(uint256)",
    "isApprovedForAll(address,address)",
    "tokenURI(uint256)",
    "safeMint(address,uint256)",
    "balanceOfBatch(address[],uint256[])",
    "safeBatchTransferFrom(address,address,uint256[],uint256[],bytes)",
    "uri(uint256)",
    "supportsInterface(bytes4)",
    # admin / access control
    "owner()",
    "transferOwnership(address)",
    "renounceOwnership()",
    "pause()",
    "unpause()",
    "paused()",
    "hasRole(bytes32,address)",
    "grantRole(bytes32,address)",
    "revokeRole(bytes32,address)",
    "renounceRole(bytes32,address)",
    "getRoleAdmin(bytes32)",
    # payments / vaults
    "deposit()",
    "deposit(uint256)",
    "withdraw()",
    "withdraw(uint256)",
    "withdrawTo(address,uint256)",
    "claim()",
    "stake(uint256)",
    "unstake(uint256)",
    "getReward()",
    "exit()",
    "sweep(address)",
    "rescueERC20(address,uint256)",
    # proxies / upgrades
    "implementation()",
    "upgradeTo(address)",
    "upgradeToAndCall(address,bytes)",
    "admin()",
    "changeAdmin(address)",
    "initialize()",
    "initialize(address)",
    # misc frequent
    "fallback()",
    "receive()",
    "kill()",
    "destroy()",
    "selfdestruct(address)",
    "setOwner(address)",
    "getBalance()",
    "getOwner()",
    "multicall(bytes[])",
    "permit(address,address,uint256,uint256,uint8,bytes32,bytes32)",
    "nonces(address)",
    "DOMAIN_SEPARATOR()",
    "execute(address,uint256,bytes)",
    "swap(uint256,uint256,address,bytes)",
    "getAmountsOut(uint256,address[])",
    "addLiquidity(address,address,uint256,uint256,uint256,uint256,address,uint256)",
    "flashLoan(address,address,uint256,bytes)",
]
