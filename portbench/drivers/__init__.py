"""Window drivers: a traffic file names the one that runs its cell."""
