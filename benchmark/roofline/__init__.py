"""The least work of each kernel and the card's peaks."""
