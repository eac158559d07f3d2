"""Plain references of the configurations and the comparison that decides
`correct`.  Nothing here imports the program."""
