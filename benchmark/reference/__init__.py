"""The plain reference: a frozen Ed25519 oracle that decides `correct`.
Nothing here imports the program."""
