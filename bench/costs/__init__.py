"""The benchmark's frozen byte models and the card's published peaks."""
