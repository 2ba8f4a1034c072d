"""The benchmark's generic pieces: the run, rooms, weights, spans and trace."""
