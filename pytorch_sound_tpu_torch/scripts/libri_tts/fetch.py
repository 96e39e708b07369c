"""Restructure an extracted LibriTTS tree into {train,valid}/{speaker}/{wav,txt}/:
the port's copy of ``pytorch_sound_tpu/scripts/libri_tts/fetch.py``. It copies
local files with shutil and downloads nothing.

LibriTTS raw layout:
    train-clean-100/<speaker>/<book>/<id>.wav
                                     <id>.normalized.txt
                                     <id>.original.txt
"""

import glob
import os
import shutil


def fetch_structure(data_dir: str, out_dir: str, target_txt: str = 'normalized',
                    is_clean: bool = False):
    """Flatten book subdirs into per-speaker wav/txt dirs under train/valid."""
    if is_clean:
        target_dirs = ['train-clean-100', 'train-clean-360', 'dev-clean']
    else:
        target_dirs = ['train-clean-100', 'train-clean-360', 'train-other-500',
                       'dev-clean', 'dev-other']
    if target_txt not in ('normalized', 'original'):
        raise ValueError('target_txt must be "normalized" or "original", got %r' % (target_txt,))

    for target_name in target_dirs:
        target_dir = os.path.join(data_dir, target_name)
        if not os.path.isdir(target_dir):
            continue
        mid_dir = 'train' if 'train' in target_name else 'valid'
        speakers = os.listdir(target_dir)
        print('Copying on {} ({} speakers) ...'.format(target_name, len(speakers)))
        for speaker in speakers:
            sub_wav_dir = os.path.join(out_dir, mid_dir, speaker, 'wav')
            sub_txt_dir = os.path.join(out_dir, mid_dir, speaker, 'txt')
            os.makedirs(sub_wav_dir, exist_ok=True)
            os.makedirs(sub_txt_dir, exist_ok=True)

            for wav in glob.glob(os.path.join(target_dir, speaker, '**', '*.wav')):
                shutil.copy(wav, sub_wav_dir)
            suffix = '.{}.txt'.format(target_txt)
            for txt in glob.glob(os.path.join(target_dir, speaker, '**', '*' + suffix)):
                out_name = os.path.basename(txt).replace(suffix, '.txt')
                shutil.copy(txt, os.path.join(sub_txt_dir, out_name))


if __name__ == '__main__':
    from pytorch_sound_tpu_torch.utils.cli import fire_like
    fire_like(fetch_structure)
