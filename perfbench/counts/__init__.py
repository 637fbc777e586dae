"""The work of the algorithm, counted from shapes, and the card's peaks."""
