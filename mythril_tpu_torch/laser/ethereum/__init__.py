"""The host symbolic EVM engine (LASER): path states over the SMT layer,
the instruction semantics, the transaction drivers and the search
strategies that the host walk runs."""
