"""L3 stages: the visibility index and the pairwise frame relations, as
torch programs on the card."""
