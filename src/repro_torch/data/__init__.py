from .synthetic import SyntheticTokens
