"""Operations and bytes of the configurations' families, from their shapes."""
